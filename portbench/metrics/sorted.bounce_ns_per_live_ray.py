"""sorted.bounce_ns_per_live_ray: device nanoseconds launched under the
sorted driver's `sorted.bounce` span (K2 with the K3 walk), over the rays
entering those bounces (the program's `sorted.live_rays` counter), in the
profile of portbench/spans.py."""
from portbench import spans

NAME = "sorted.bounce_ns_per_live_ray"


def count(run):
    return spans.measure(run)


def read(run):
    a = run.counted.get(NAME)
    ms = a.device_ms("sorted.bounce") if a is not None else None
    rays = a.counters.get("sorted.live_rays") if a is not None else None
    if ms is None or not rays:
        return None
    return ms * a.steps * 1e6 / rays
