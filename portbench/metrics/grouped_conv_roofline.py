"""grouped_conv_roofline: the grouped convs' share of their roofline."""
from portbench.readers import grouped_conv_roofline


def read(run):
    return grouped_conv_roofline(run)
