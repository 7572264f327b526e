"""host_ms_per_batch.synth: milliseconds a synthesis batch less the
program's ``synth/fetch`` waits for the device."""
from portbench.phases import host_ms_per_batch


def read(run):
    return host_ms_per_batch(run)
