// Per-ray xorshift32 stream seeded through the murmur3 finaliser: the port of
// _seed_rng / _fmix32 / _next_u01 in
// cpupathtrace_tpu/integrator/pallas_megakernel.py:96-138. The torch twin is
// cpupathtrace_tpu_torch/integrator/rng.py; both give the TPU's bits.
#pragma once

#include <stdint.h>

namespace ptx {

// The TPU megakernel seeds each lane by (program id, row, lane) of its ray
// block of 128 lanes: 64 rows for dense scenes, 8 rows for binned ones
// (pallas_megakernel.py _BLOCK_ROWS / _KRN_BLOCK_ROWS).
constexpr int kBlockRows = 64;
constexpr int kBinnedBlockRows = 8;
constexpr int kLanes = 128;

__device__ __forceinline__ uint32_t fmix32(uint32_t s) {
  s ^= s >> 16;
  s *= 0x85EBCA6Bu;
  s ^= s >> 13;
  s *= 0xC2B2AE35u;
  s ^= s >> 16;
  return s | 1u;
}

// State of global ray i in blocks of kRows x 128 rays: seed + pid * 1000003
// wraps as int32 and is read as uint32, which is the same as wrapping in
// uint32.
template <int kRows = kBlockRows>
__device__ __forceinline__ uint32_t seed_rng(int32_t seed, int64_t i) {
  const uint32_t pid = static_cast<uint32_t>(i / (kRows * kLanes));
  const uint32_t row = static_cast<uint32_t>((i / kLanes) % kRows);
  const uint32_t lane = static_cast<uint32_t>(i % kLanes);
  const uint32_t s0 = static_cast<uint32_t>(seed) + pid * 1000003u;
  const uint32_t s = (s0 * 2654435761u) ^ (row * 40503u + 0x9E3779B9u) ^
                     (lane * 2246822519u + 0x85EBCA6Bu);
  return fmix32(s);
}

// Advance xorshift32 and return a uniform in [0, 1) from the top 24 bits.
__device__ __forceinline__ float next_u01(uint32_t& s) {
  s ^= s << 13;
  s ^= s >> 17;
  s ^= s << 5;
  return static_cast<float>(static_cast<int32_t>(s >> 8)) * (1.0f / 16777216.0f);
}

}  // namespace ptx
