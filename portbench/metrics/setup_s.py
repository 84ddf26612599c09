"""setup_s: seconds from the process's start to the start of the measured
window: imports, the weights drawn on the device, the program built, the
kernels built where the checkout has none yet, and the cell's warm-up."""


def read(obs: dict):
    return obs.get("setup_s")
