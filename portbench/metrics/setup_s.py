"""setup_s: seconds from the process's start to the end of the warm-up
step (imports, the kernels' build or load, the scene's build or cache hit
and upload, one step of the cell's shape). Host clock."""


def read(run):
    return run.setup_s
