"""diff.backward_ms_per_pass: device milliseconds a gradient pass launches
under the program's `diff.backward` span (`_TraceDiff.backward`: the replay
vjp kernel over K2's record planes and its fold, on autograd's thread), in
the profile of portbench/spans.py."""
from portbench import spans

NAME = "diff.backward_ms_per_pass"


def count(run):
    return spans.measure(run)


def read(run):
    a = run.counted.get(NAME)
    return a.device_ms("diff.backward") if a is not None else None
