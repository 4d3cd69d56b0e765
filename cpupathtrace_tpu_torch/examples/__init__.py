"""Examples of the port, each run as `python -m cpupathtrace_tpu_torch.examples.<name>`."""
