"""Checkpoints of the train state with the reference's retention policy.

Counterpart of ``ste_gan_tpu/train/checkpoint.py``, on ``torch.save`` and
``torch.load(weights_only=True)`` in place of Orbax. The reference keeps
(ste_gan/train.py:370-374,421-466,478-494): periodic checkpoints every
``interval_save`` steps, a ``-final`` checkpoint at max_steps, a ``-last``
checkpoint every few epochs, and ``best`` weights selected by validation
speech-unit error; resume picks the highest-numbered periodic checkpoint.

Each checkpoint is a directory ``<run>/<tag>/`` holding one ``state.pt``:
a tree (nested dicts and lists) of tensors and ints, in practice
:func:`ste_gan_torch.train.gan.state_tree`. Beside it ``<tag>.meta.json``
records the epoch (and, for ``best``, the validation SU error). A write
lands in ``<tag>.inflight`` and is renamed to ``<tag>`` only when complete.

The port's parameters, moments and EMA update in place, and the AdamW
kernel's tables hold their addresses. So a save first copies the tree to
the host (a later step cannot reach the file), and a restore copies into
the template's own tensors; it never rebinds them.
"""
from __future__ import annotations

import json
import logging
import re
import shutil
import threading
from pathlib import Path
from typing import Any, List, Optional, Tuple

import torch

_STEP_RE = re.compile(r"checkpoint-(\d+)$")
_INFLIGHT_SUFFIX = ".inflight"
_STATE_FILE = "state.pt"
_TAGS = ("checkpoint-final", "checkpoint-last", "best")


def host_copy(tree: Any) -> Any:
    """A copy of ``tree`` whose tensors are new CPU tensors (copied even
    when the source already lies on the CPU)."""
    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [host_copy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def copy_into(template: Any, saved: Any, where: str = "") -> Any:
    """Copy ``saved`` into the tensors of ``template`` in place and return
    the template's structure with its own tensors and the saved non-tensor
    leaves. Structure, shapes and dtypes must match."""
    if isinstance(template, dict):
        if not isinstance(saved, dict):
            raise ValueError(f"checkpoint entry {where or '/'} is not a dict")
        missing = sorted(set(template) - set(saved))
        extra = sorted(set(saved) - set(template))
        if missing or extra:
            raise ValueError(f"checkpoint entries under {where or '/'} do not "
                             f"match the state: missing {missing}, "
                             f"unexpected {extra}")
        return {k: copy_into(v, saved[k], f"{where}/{k}")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(template):
            raise ValueError(f"checkpoint entry {where} has "
                             f"{len(saved) if isinstance(saved, (list, tuple)) else 'no'}"
                             f" items, the state {len(template)}")
        return [copy_into(t, s, f"{where}/{i}")
                for i, (t, s) in enumerate(zip(template, saved))]
    if isinstance(template, torch.Tensor):
        if (not isinstance(saved, torch.Tensor) or saved.shape != template.shape
                or saved.dtype != template.dtype):
            raise ValueError(
                f"checkpoint entry {where}: {getattr(saved, 'dtype', type(saved))}"
                f" {tuple(getattr(saved, 'shape', ()))} does not match the "
                f"state's {template.dtype} {tuple(template.shape)}")
        with torch.no_grad():
            template.copy_(saved)
        return template
    return saved


def _check_ema(template: Any, saved: Any, path: Path) -> None:
    """An EMA config needs a checkpoint with ``gen_ema`` and the reverse:
    name the setting instead of failing on a missing entry."""
    if not (isinstance(template, dict) and isinstance(saved, dict)
            and "generator" in template):
        return
    if "gen_ema" in template and "gen_ema" not in saved:
        raise ValueError(
            f"checkpoint at {path} holds no generator EMA (it was written with "
            f"train.generator_ema = 0) but this config has train.generator_ema "
            f"> 0; resume with generator_ema: 0, or enable the EMA from step 0 "
            f"of a new run")
    if "gen_ema" in saved and "gen_ema" not in template:
        raise ValueError(
            f"checkpoint at {path} holds a generator EMA (train.generator_ema "
            f"> 0) but this config has train.generator_ema = 0; resume with "
            f"the generator_ema the run was started with")


class CheckpointManager:
    def __init__(self, run_dir: Path):
        self.run_dir = Path(run_dir).resolve()
        self.run_dir.mkdir(parents=True, exist_ok=True)
        # (thread, errors, tmp_path, tag, meta) of a background save not
        # yet promoted.
        self._pending: Optional[Tuple[threading.Thread, List[BaseException],
                                      Path, str, dict]] = None

    # ------------------------------------------------------------------
    def _path(self, tag: str) -> Path:
        return self.run_dir / tag

    def _finalize_pending(self) -> None:
        """Wait for the in-flight background write, then rename it to its
        final tag and write meta.json. Until this point the PREVIOUS
        checkpoint under the tag stays intact on disk, and meta.json never
        describes a checkpoint whose data write failed."""
        if self._pending is None:
            return
        thread, errors, tmp, tag, meta = self._pending
        self._pending = None
        thread.join()
        if errors:
            logging.error("background checkpoint write for %r failed: %r",
                          tag, errors[0])
            return
        final = self._path(tag)
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        (self.run_dir / f"{tag}.meta.json").write_text(json.dumps(meta))

    def save(self, tag: str, tree: Any, epoch: int = 0,
             block: bool = True, extra_meta: Optional[dict] = None) -> None:
        """Save a checkpoint. The tree is copied to the host before this
        returns; with ``block=False`` the disk write then runs in a thread,
        overlapped with training. The write lands in
        ``<tag>.inflight`` and is promoted to ``<tag>`` (and only then gets
        its meta.json) once it finishes — at the start of the next save, or
        in :meth:`wait_until_finished`."""
        self._finalize_pending()
        snapshot = host_copy(tree)
        tmp = self._path(f"{tag}{_INFLIGHT_SUFFIX}")
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        errors: List[BaseException] = []

        def write():
            try:
                torch.save(snapshot, tmp / _STATE_FILE)
            except Exception as exc:  # reported when the save is finalized
                errors.append(exc)

        thread = threading.Thread(target=write, daemon=True)
        thread.start()
        meta = {**(extra_meta or {}), "epoch": int(epoch)}
        self._pending = (thread, errors, tmp, tag, meta)
        if block:
            self._finalize_pending()

    def wait_until_finished(self) -> None:
        self._finalize_pending()

    def restore(self, tag: str, template: Any) -> Tuple[Any, int]:
        """Copy checkpoint ``tag`` into ``template``'s tensors; returns the
        restored tree (see :func:`copy_into`) and the epoch."""
        path = self._path(tag)
        saved = torch.load(path / _STATE_FILE, map_location="cpu",
                           weights_only=True)
        _check_ema(template, saved, path)
        tree = copy_into(template, saved)
        meta_path = self.run_dir / f"{tag}.meta.json"
        epoch = 0
        if meta_path.exists():
            epoch = int(json.loads(meta_path.read_text()).get("epoch", 0))
        return tree, epoch

    # ------------------------------------------------------------------
    def save_periodic(self, tree, step: int, epoch: int,
                      block: bool = False) -> None:
        self.save(f"checkpoint-{step:08d}", tree, epoch, block=block)

    def save_final(self, tree, epoch: int) -> None:
        # Final saves block: the process exits right after.
        self.save("checkpoint-final", tree, epoch, block=True)

    def save_last(self, tree, epoch: int) -> None:
        self.save("checkpoint-last", tree, epoch, block=False)

    def save_best(self, tree, epoch: int,
                  su_error: Optional[float] = None) -> None:
        """``su_error`` is persisted in best.meta.json so a resumed run
        initialises its best-so-far from the historical best instead of
        +inf."""
        extra = {} if su_error is None else {"su_error": float(su_error)}
        self.save("best", tree, epoch, block=False, extra_meta=extra)

    def best_su_error(self) -> float:
        """Historical best validation speech-unit error recorded next to
        the ``best`` checkpoint; +inf when absent."""
        meta_path = self.run_dir / "best.meta.json"
        if meta_path.exists() and self._path("best").is_dir():
            try:
                return float(json.loads(meta_path.read_text()).get(
                    "su_error", float("inf")))
            except (ValueError, json.JSONDecodeError):
                return float("inf")
        return float("inf")

    def latest_periodic_tag(self) -> Optional[str]:
        steps = []
        for path in self.run_dir.glob("checkpoint-*"):
            match = _STEP_RE.match(path.name)
            if match and path.is_dir():
                steps.append(int(match.group(1)))
        if not steps:
            if self._path("checkpoint-last").is_dir():
                return "checkpoint-last"
            if self._path("checkpoint-final").is_dir():
                return "checkpoint-final"
            return None
        return f"checkpoint-{max(steps):08d}"

    def restore_latest(self, template: Any) -> Optional[Tuple[Any, int]]:
        tag = self.latest_periodic_tag()
        if tag is None:
            return None
        logging.info("Resuming from checkpoint: %s", self._path(tag))
        return self.restore(tag, template)


def restore_from_path(path: Path, template: Any) -> Tuple[Any, int]:
    """Restore a train state from an explicit ``--checkpoint`` path: a
    single checkpoint directory (``<run>/checkpoint-00010000``,
    ``<run>/best``) or a run directory, whose newest checkpoint is used."""
    path = Path(path).resolve()
    if not path.is_dir():
        raise FileNotFoundError(f"--checkpoint path does not exist: {path}")
    if _STEP_RE.match(path.name) or path.name in _TAGS:
        logging.info("Restoring from explicit checkpoint: %s", path)
        return CheckpointManager(path.parent).restore(path.name, template)
    restored = CheckpointManager(path).restore_latest(template)
    if restored is None:
        raise FileNotFoundError(f"No checkpoints found under run dir: {path}")
    return restored


# ---------------------------------------------------------------------------
# Standalone trees (a frozen EMG encoder, exported weights)
# ---------------------------------------------------------------------------


def save_pytree(path: Path, tree: Any) -> None:
    """Write a tree of tensors to the file ``path``."""
    path = Path(path).resolve()
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(host_copy(tree), path)


def load_pytree(path: Path, template: Any = None) -> Any:
    """Read a tree written by :func:`save_pytree`. With a ``template`` the
    values are copied into its tensors (structure, shapes and dtypes must
    match) and the template's tree is returned."""
    saved = torch.load(Path(path).resolve(), map_location="cpu",
                       weights_only=True)
    return saved if template is None else copy_into(template, saved)
