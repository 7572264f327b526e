"""adamw_roofline.gan_train: the GAN step's two AdamW updates' share of
their roofline (28 bytes a parameter), over the device time of what the
program's ``adamw`` span launched."""
from portbench.phases import adamw_roofline


def read(run):
    return adamw_roofline(run)
