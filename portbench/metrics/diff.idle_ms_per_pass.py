"""diff.idle_ms_per_pass: milliseconds a gradient pass in which the card is
idle while the innermost program span on the calling thread is the
gradient driver's (`diff.*`: the record form's host reads, preprocessing,
waiting in `torch.autograd.grad`), in the profile of portbench/spans.py."""
from portbench import spans

NAME = "diff.idle_ms_per_pass"


def count(run):
    return spans.measure(run)


def read(run):
    a = run.counted.get(NAME)
    return a.idle_ms("diff") if a is not None else None
