"""K2 (``cascade_mlp_kernel``): a launch's bound over its mean device time
in the traced window, in % (``roofline.kernel_share``)."""
from portbench.roofline import kernel_share


def read(run):
    return kernel_share(run, "cascade_mlp_kernel")
