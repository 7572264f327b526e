"""Fully-sharded data parallelism of the GAN train step: the persistent
train state stored sharded over the ranks.

Counterpart of ``ste_gan_tpu/parallel/fsdp.py`` (``fsdp_wrap_gan_step``).
Between steps each rank holds one slice of the generator's and the
discriminator's parameters, of both AdamW moment sets and of the EMA, so
the persistent state per rank falls to about ``1/ranks`` of the replicated
one. A step:

1. ``all_gather_into_tensor`` rebuilds both networks' full parameters;
2. the unchanged step (``train.gan.make_train_step``) runs its forward and
   backward on them;
3. for each network, ``reduce_scatter_tensor`` (a sum, then a divide by
   the rank count) gives this rank its slice of the mean gradient, and the
   hand-written AdamW kernel (``ops/fused_adamw.py``) updates this rank's
   slices of parameters and moments; D's full parameters are gathered again
   at once, since G's losses go through the updated D;
4. the EMA follows on the slice, and the full parameters are freed.

Placement: each network's parameters are one flat f32 buffer (each
parameter starting on a 128-byte boundary, so kernels see the alignment a
tensor of its own has), padded to a multiple of the rank count and split
evenly, where the JAX rule shards
every leaf on its largest evenly divisible axis (``fsdp.py:75-103``) and
replicates the leaves it cannot split. Per-rank memory falls about
``1/ranks`` under both. The spectral-norm ``u``/``v`` stay replicated, as
in JAX, and so does the frozen encoder (the port keeps it outside the
train state).

Hybrid FSDP x TP (``ste_gan_tpu/train/train_gan.py:129-135``): under
tensor parallelism the group given here is the data group of the 2-D
layout (``parallel/tensor_parallel.py``), and the parameters are the model
rank's slabs, so each model rank's local leaves go into ``FlatShard``s
over its data ranks: per-rank state falls to about ``1/(data x model)``.

Why not FSDP2's ``fully_shard``: it turns parameters into DTensors and
hooks module forwards and backwards, while this step calls
``torch.autograd.grad`` on explicit parameter lists, runs a hand kernel on
raw f32 storage and keeps the spectral state and the EMA outside any
module.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ste_gan_torch.ops.fused_adamw import AdamWState, adamw_state, fused_adamw_
from ste_gan_torch.parallel.mesh import ProcessGroup, rank_and_size

__all__ = ["FlatShard", "ShardedGANState", "fsdp_wrap_gan_step",
           "fsdp_sharding_summary", "shard_numel"]

#: Elements (f32) each parameter's offset in a flat buffer is a multiple of.
ALIGN = 32


def _offsets(numels: Sequence[int]) -> List[int]:
    """Start of each parameter in a flat buffer, ``ALIGN``-aligned, and
    the used length last."""
    out, at = [], 0
    for n in numels:
        out.append(at)
        at += -(-n // ALIGN) * ALIGN
    return out + [at]


def shard_numel(numels: Sequence[int], size: int) -> int:
    """Elements of each rank's slice of the flat buffer of parameters of
    ``numels`` elements at ``size`` ranks."""
    return -(-_offsets(numels)[-1] // size)


class FlatShard:
    """One network's parameters as a flat f32 buffer of ``size * shard_numel``
    elements (zero padded, parameters at ``ALIGN``-element offsets). The
    module's parameters become views of the full buffer, whose storage
    exists only between :meth:`gather` and :meth:`release`; :attr:`shard`
    is this rank's slice, kept."""

    def __init__(self, params: Sequence[torch.Tensor], group: ProcessGroup):
        self.group = group
        self.rank, self.size = rank_and_size(group)
        self.params = list(params)
        self.numels = [p.numel() for p in self.params]
        self.offsets = _offsets(self.numels)
        self.shard_numel = shard_numel(self.numels, self.size)
        self.full = self.flatten(self.params)
        self._nbytes = self.full.numel() * self.full.element_size()
        with torch.no_grad():
            for p, at, n in zip(self.params, self.offsets, self.numels):
                p.data = self.full[at:at + n].view_as(p)
        self.shard = self.full[self._rows()].clone()

    def _rows(self) -> slice:
        return slice(self.rank * self.shard_numel,
                     (self.rank + 1) * self.shard_numel)

    def flatten(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """A new padded flat f32 copy of tensors shaped like the
        parameters."""
        flat = torch.zeros(self.size * self.shard_numel, dtype=torch.float32,
                           device=self.params[0].device)
        with torch.no_grad():
            torch._foreach_copy_(self._views(flat),
                                 [t.reshape(-1) for t in tensors])
        return flat

    def _views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """Each parameter's 1-D span of ``flat``."""
        return [flat[at:at + n] for at, n in zip(self.offsets, self.numels)]

    def shard_of(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """This rank's slice of tensors shaped like the parameters."""
        return self.flatten(tensors)[self._rows()].clone()

    def _all_gather(self, out: torch.Tensor, shard: torch.Tensor) -> None:
        if self.group is None:
            out.copy_(shard)
        else:
            dist.all_gather_into_tensor(out, shard, group=self.group)

    def gather(self, shard: Optional[torch.Tensor] = None) -> None:
        """The full parameters from every rank's :attr:`shard` (or from
        ``shard``, a slice laid out like it: the EMA's)."""
        storage = self.full.untyped_storage()
        if storage.nbytes() == 0:
            storage.resize_(self._nbytes)
        with torch.no_grad():
            self._all_gather(self.full, self.shard if shard is None else shard)

    def release(self) -> None:
        """Free the full parameters' storage (the views stay, empty)."""
        self.full.untyped_storage().resize_(0)

    def gathered(self, shard: torch.Tensor) -> List[torch.Tensor]:
        """New full tensors shaped like the parameters from every rank's
        ``shard`` (moments, EMA): views of one new flat buffer."""
        flat = torch.empty(self.size * self.shard_numel, dtype=torch.float32,
                           device=shard.device)
        self._all_gather(flat, shard)
        return [v.view(p.shape) for v, p in zip(self._views(flat), self.params)]

    def reduce_scatter(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """This rank's slice of the gradients' mean over the ranks."""
        flat = self.flatten(grads)
        if self.group is None:
            return flat
        out = torch.empty(self.shard_numel, dtype=torch.float32,
                          device=flat.device)
        dist.reduce_scatter_tensor(out, flat, group=self.group)
        return out.div_(self.size)

    def held_bytes(self) -> int:
        """Bytes this object holds now: the shard, and the full buffer
        while gathered."""
        return (self.shard.numel() * 4
                + self.full.untyped_storage().nbytes())


class ShardedGANState:
    """The GAN train state stored sharded (see the module docstring).

    Built from a replicated state (after any restore): the models'
    parameters move into :class:`FlatShard` buffers, and ``state.opt_g``,
    ``state.opt_d`` and ``state.gen_ema`` are replaced by AdamW states and
    an EMA over this rank's slices. Called as ``update(name, opt, grads)``
    it is the step's update of one network. ``timed``: :attr:`comm_s`
    accumulates the reduce-scatters' and the mid-step gather's wall time
    between device synchronisations."""

    def __init__(self, models, state, group: ProcessGroup,
                 timed: bool = False):
        self.models = models
        self.state = state
        self.group = group
        self.timed = timed
        self.comm_s = 0.0
        self.g = FlatShard(list(models.generator.parameters()), group)
        self.d = FlatShard(list(models.discriminator.parameters()), group)
        state.opt_g = self._shard_opt(state.opt_g, self.g)
        state.opt_d = self._shard_opt(state.opt_d, self.d)
        if state.gen_ema is not None:
            state.gen_ema = [self.g.shard_of(state.gen_ema)]
        self.release()

    @staticmethod
    def _shard_opt(opt: AdamWState, flat: FlatShard) -> AdamWState:
        return adamw_state([flat.shard], [flat.shard_of(opt.exp_avg)],
                           [flat.shard_of(opt.exp_avg_sq)], opt.hyper,
                           opt.count)

    def gather(self) -> None:
        self.g.gather()
        self.d.gather()

    def release(self) -> None:
        self.g.release()
        self.d.release()

    def _sync(self) -> None:
        if self.timed and self.g.shard.device.type == "cuda":
            torch.cuda.synchronize()

    def __call__(self, name: str, opt: AdamWState,
                 grads: Sequence[torch.Tensor]) -> None:
        flat = self.g if name == "g" else self.d
        self._sync()
        t0 = time.perf_counter()
        grad_shard = flat.reduce_scatter(list(grads))
        self._sync()
        self.comm_s += time.perf_counter() - t0
        fused_adamw_(opt, [grad_shard])
        if name == "d":
            # G's losses go through the updated discriminator.
            self._sync()
            t0 = time.perf_counter()
            flat.gather()
            self._sync()
            self.comm_s += time.perf_counter() - t0

    @contextlib.contextmanager
    def eval_generator(self) -> Iterator[torch.nn.Module]:
        """The generator holding the weights evaluation uses (the EMA's
        when EMA training is on), gathered for the block, freed after it.
        Every rank enters it together."""
        ema = self.state.gen_ema
        self.g.gather(ema[0] if ema is not None else None)
        try:
            yield self.models.generator
        finally:
            self.g.release()

    def state_tree(self) -> Dict:
        """The full train state in ``train.gan.state_tree``'s layout (new
        tensors), so a checkpoint of it has the single-device format and
        resumes at any rank count. Every rank calls it together."""
        state, m = self.state, self.models
        self.gather()
        try:
            tree = {
                "step": int(state.step),
                "generator": {k: v.detach().clone()
                              for k, v in m.generator.state_dict().items()},
                "discriminator": {
                    k: v.detach().clone()
                    for k, v in m.discriminator.state_dict().items()},
                "opt_g": self._opt_tree(state.opt_g, self.g),
                "opt_d": self._opt_tree(state.opt_d, self.d),
            }
            if state.gen_ema is not None:
                tree["gen_ema"] = self.g.gathered(state.gen_ema[0])
        finally:
            self.release()
        return tree

    @staticmethod
    def _opt_tree(opt: AdamWState, flat: FlatShard) -> Dict:
        return {"exp_avg": flat.gathered(opt.exp_avg[0]),
                "exp_avg_sq": flat.gathered(opt.exp_avg_sq[0]),
                "count": opt.count, "hyper": opt.hyper}

    def persistent_bytes(self) -> int:
        """Bytes of train state this rank holds between steps: its slices
        of parameters, moments and EMA, and the replicated buffers."""
        state, m = self.state, self.models
        slices = [state.opt_g.exp_avg[0], state.opt_g.exp_avg_sq[0],
                  state.opt_d.exp_avg[0], state.opt_d.exp_avg_sq[0]]
        slices += state.gen_ema or []
        buffers = list(m.generator.buffers()) + list(m.discriminator.buffers())
        return (self.g.held_bytes() + self.d.held_bytes()
                + sum(t.numel() * t.element_size() for t in slices + buffers))


def fsdp_wrap_gan_step(cfg, models, state, group: ProcessGroup,
                       timed: bool = False
                       ) -> Tuple[Callable, ShardedGANState]:
    """Shard ``state`` (see :class:`ShardedGANState`) and return the step
    over it, ``step(state, batch) -> (state, metrics)`` on this rank's
    rows of the global batch, with the sharded state."""
    from ste_gan_torch.train.gan import make_train_step

    sharded = ShardedGANState(models, state, group, timed=timed)
    inner = make_train_step(cfg, models, group=group, update=sharded)

    def step(state, batch):
        sharded.gather()
        try:
            return inner(state, batch)
        finally:
            sharded.release()

    return step, sharded


def fsdp_sharding_summary(models, ema: bool, size: int) -> Dict[str, int]:
    """Persistent train-state bytes per rank under this module's rule at
    ``size`` ranks, against the replicated layout: parameters, both moment
    sets and (``ema``) the generator EMA in f32, plus the replicated
    buffers (spectral ``u``/``v``)."""
    n_g = [p.numel() for p in models.generator.parameters()]
    n_d = [p.numel() for p in models.discriminator.parameters()]
    buffers = sum(b.numel() * b.element_size()
                  for mod in (models.generator, models.discriminator)
                  for b in mod.buffers())
    copies_g = 3 + int(ema)

    def state_bytes(ranks: int) -> int:
        return 4 * (shard_numel(n_g, ranks) * copies_g
                    + shard_numel(n_d, ranks) * 3) + buffers

    return {"ranks": size,
            "params": sum(p.numel() for mod in (models.generator,
                                                 models.discriminator)
                          for p in mod.parameters()),
            "replicated_bytes": state_bytes(1),
            "per_rank_bytes": state_bytes(size)}
