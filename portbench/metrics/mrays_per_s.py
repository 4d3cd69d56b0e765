"""mrays_per_s: width x height x spp of every frame the window completed
(x min_spp for adaptive frames: a constant of the traffic), over the
window's seconds, in millions. Host clock."""


def read(run):
    return run.steps * run.entry.work() / run.elapsed / 1e6
