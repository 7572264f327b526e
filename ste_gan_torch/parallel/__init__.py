"""Training and synthesis over several ranks: one process per card.

Counterpart of the data-parallel family of ``ste_gan_tpu/parallel/``:

* ``mesh.py``: the process group, batch slicing, the coalesced gradient
  all-reduce and the collectives that carry a gradient;
* ``fsdp.py``: the GAN train state stored sharded over the ranks;
* ``multiprocess.py``: the worker one rank of a fleet runs;
* ``launch.py``: the supervisor that runs, watches and recovers a fleet.

Tensor, pipeline, expert and sequence parallelism are not ported yet
(``ROADMAP.md`` §1); the settings that ask for them raise.
"""
