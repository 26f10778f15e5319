"""setup_s: process start to the first timed step, on the host's clock:
imports, the kernels' build (the first run in a checkout), the weights and
inputs drawn on the device, the warm-up of every shape the traffic uses."""


def read(run):
    return run.setup_s
