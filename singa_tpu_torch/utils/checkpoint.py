"""Checkpoint / resume, ported from ``singa_tpu/utils/checkpoint.py``:
``save_states``/``load_states`` write and read one ``.npz`` with atomic
writes, ``CheckpointManager`` keeps stepped checkpoints.

The file format is the reference's, key for key, so a file written by
either package loads in the other: parameters and persistent buffers by
attribute path; optimizer moments under ``__opt__:<i>`` keys, in the
order of a {param-name, leaf-count} manifest; a json aux with
``optimizer`` (the step), ``opt_signature`` and ``opt_slots``; and a
manifest of every array with a sha256 digest over aux and manifest, so
a torn or mixed file is refused before any state changes.

Multi-process (a ``torch.distributed`` group): every rank collects the
states, which gathers what ranks hold apart (DistOpt's per-rank
error-feedback residuals into one (world, *shape) array, ZeRO-1's slot
shards into their natural shapes), rank 0 writes the file and a
barrier ends the save, so no rank reads a half-written checkpoint.
Every rank restores from the same path (a shared filesystem), and
DistOpt hands each rank its residual row or slot shard back.

A load copies into the model's existing parameter storage (a captured
step reads parameters by address), places the moments on the
parameters' device, and drops the model's step executors and their
captured graphs, so the next step re-seeds from the restored moments
and captures again.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import tempfile
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..parallel import pipeline
from ..parallel import tensor_parallel as tp

__all__ = ["save_states", "load_states", "save_arrays", "load_arrays",
           "atomic_write", "check_opt_manifest", "CheckpointManager"]

_AUX_KEY = "__aux__"
_MANIFEST_KEY = "__arrays__"
_DIGEST_KEY = "__digest__"
_OPT_PREFIX = "__opt__:"


def _manifest_of(arrays: Dict[str, np.ndarray]) -> Dict[str, List]:
    return {k: [list(np.asarray(v).shape), str(np.asarray(v).dtype)]
            for k, v in arrays.items()}


def _digest(aux_json: str, manifest_json: str) -> str:
    h = hashlib.sha256()
    h.update(aux_json.encode())
    h.update(manifest_json.encode())
    return h.hexdigest()


def atomic_write(fpath: str, write_fn, mode: str = "wb") -> None:
    """Temp file in the target dir, ``write_fn(f)``, fsync, atomic
    rename.  The temp file never outlives a failed write, and its
    cleanup does not mask the original error."""
    d = os.path.dirname(os.path.abspath(fpath)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, mode) as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, fpath)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def save_arrays(arrays: Dict[str, np.ndarray], fpath: str,
                aux: Optional[Dict] = None) -> None:
    """Atomic write of `arrays` with a manifest of every member (name,
    shape, dtype, the optimizer moments included) and a digest over aux
    and manifest, which `load_arrays` checks."""
    def _write(f):
        aux_json = json.dumps(aux or {}, sort_keys=True)
        manifest_json = json.dumps(_manifest_of(arrays), sort_keys=True)
        meta = {_AUX_KEY: aux_json, _MANIFEST_KEY: manifest_json,
                _DIGEST_KEY: _digest(aux_json, manifest_json)}
        np.savez(f, __meta__=json.dumps(meta), **arrays)

    atomic_write(fpath, _write)


def load_arrays(fpath: str):
    """(arrays, aux) of a file `save_arrays` wrote; raises on a digest
    or manifest mismatch."""
    with np.load(fpath, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    aux_json = meta.get(_AUX_KEY, "{}")
    aux = json.loads(aux_json)
    manifest_json = meta.get(_MANIFEST_KEY)
    if manifest_json is not None:   # pre-manifest files load unchecked
        stored = meta.get(_DIGEST_KEY)
        if stored != _digest(aux_json, manifest_json):
            raise ValueError(
                f"{fpath}: aux/manifest digest mismatch — metadata was "
                f"tampered with or the write was torn")
        manifest = json.loads(manifest_json)
        missing = sorted(set(manifest) - set(arrays))
        extra = sorted(set(arrays) - set(manifest))
        if missing or extra:
            raise ValueError(
                f"{fpath}: array members do not match the manifest "
                f"(missing: {missing}, unexpected: {extra}) — params/"
                f"optimizer-moment set is inconsistent")
        for k, (shape, dtype) in manifest.items():
            a = arrays[k]
            if list(a.shape) != list(shape) or str(a.dtype) != dtype:
                raise ValueError(
                    f"{fpath}: array {k!r} is {a.shape}/{a.dtype} but the "
                    f"manifest recorded {tuple(shape)}/{dtype}")
    return arrays, aux


def _host(t: torch.Tensor) -> np.ndarray:
    # a copy even on the CPU, where .cpu() would return the parameter
    # itself: an asynchronous write must not see the next step's update
    return t.detach().to("cpu", copy=True).numpy()


def _process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _barrier() -> None:
    if _process_count() > 1:
        dist.barrier()


def _collect(model, aux_states: Optional[Dict]):
    """Parameters, persistent buffers and optimizer moments as host
    arrays, and the aux that describes them.  Every rank calls it (the
    optimizer's slot gather is a collective); only rank 0, the writer,
    copies to the host."""
    # parameters cut over a 'model' axis are gathered to their full
    # shapes (a collective), their slots with them; the blocks of the
    # other pipe stages come from the ranks that hold them (every rank
    # of a stage copies its blocks to the host for that gather)
    states = model.get_states()
    staged = {n for n, t in states.items()
              if pipeline.stage_of(t) is not None}
    first = _process_index() == 0

    def host(name, t):
        return _host(t) if first or name in staged else None
    arrays = {name: host(name, tp.full_tensor(t))
              for name, t in states.items()}
    aux = dict(aux_states or {})
    opt = getattr(model, "optimizer", None)
    slot_arrays = {}
    if opt is not None:
        slot_arrays = {
            name: [tp.full_tensor(leaf, p) if p is not None
                   and tuple(leaf.shape) == tuple(p.shape) else leaf
                   for leaf in leaves]
            for name, leaves in opt.slot_arrays().items()
            for p in [states.get(name)]}
    if staged:
        mine = {"p": {n: arrays[n] for n in staged},
                "s": {n: [_host(leaf) for leaf in slot_arrays[n]]
                      for n in staged if n in slot_arrays}}
        for theirs in pipeline.gather_stages(model, mine):
            arrays.update(theirs["p"])
            slot_arrays.update(theirs["s"])
    if opt is not None:
        aux["optimizer"] = opt.get_states()
        aux["opt_signature"] = opt.state_signature()
        host = (lambda t: t if isinstance(t, np.ndarray) else _host(t)) \
            if first else (lambda t: None)
        manifest: List = []
        i = 0
        for name in sorted(slot_arrays):
            leaves = slot_arrays[name]
            manifest.append([name, len(leaves)])
            for leaf in leaves:
                arrays[f"{_OPT_PREFIX}{i}"] = host(leaf)
                i += 1
        aux["opt_slots"] = manifest
    return arrays, aux


def save_states(model, fpath: str, aux_states: Optional[Dict] = None) -> None:
    """Reference API: model.save_states(fpath, aux_states).  With a
    process group: every rank collects, rank 0 writes, a barrier ends
    the save."""
    arrays, aux = _collect(model, aux_states)
    if _process_index() == 0:
        save_arrays(arrays, fpath, aux)
    _barrier()


def check_opt_manifest(arrays: Dict, aux: Dict) -> None:
    """The optimizer moments agree with their slot manifest, or raise
    ValueError; a pre-manifest aux passes unchecked."""
    manifest = aux.get("opt_slots")
    if manifest is None:
        return
    expected = sum(int(n) for _, n in manifest)
    got = sum(1 for k in arrays if k.startswith(_OPT_PREFIX))
    if expected != got:
        raise ValueError(
            f"checkpoint carries {got} optimizer moment arrays but its "
            f"slot manifest lists {expected} — params/opt-state "
            f"mismatch, refusing to load")


def _apply(model, arrays: Dict, aux: Dict) -> None:
    opt = getattr(model, "optimizer", None)
    manifest = aux.get("opt_slots")
    saved_sig = aux.get("opt_signature")
    # both checks come before any state changes, so a refused restore
    # leaves the model as it was: leaf counts and shapes can coincide
    # across optimizers (Adam's (m, v) and GradAccum's {acc, base}),
    # the signature cannot; moments that do not match their own
    # manifest mean a torn or mixed file
    if opt is not None and manifest is not None and saved_sig is not None \
            and saved_sig != opt.state_signature():
        raise ValueError(
            f"checkpoint optimizer state is {saved_sig!r} but the model "
            f"optimizer is {opt.state_signature()!r} — refusing to "
            f"reinterpret moments across optimizers")
    check_opt_manifest(arrays, aux)
    model.set_states({k: v for k, v in arrays.items()
                      if not k.startswith(_OPT_PREFIX)})
    model._executors.clear()
    if opt is None:
        return
    if "optimizer" in aux:
        opt.set_states(aux["optimizer"])
    if manifest is not None:
        dev = model.device.torch_device
        params = model.get_params()
        elsewhere = set(pipeline.held_elsewhere(model))
        slots, i = {}, 0
        for name, n_leaves in manifest:
            if name in elsewhere:       # another pipe stage's block
                i += n_leaves
                continue
            p = params.get(name)
            slots[name] = [
                torch.tensor(np.asarray(a if p is None else tp.to_local(p, a)),
                             device=dev)
                for a in (arrays[f"{_OPT_PREFIX}{i + j}"]
                          for j in range(n_leaves))]
            i += n_leaves
        opt.load_slot_arrays(slots)


def load_states(model, fpath: str) -> Dict:
    arrays, aux = load_arrays(fpath)
    _apply(model, arrays, aux)
    return aux


class CheckpointManager:
    """Stepped checkpoints with retention and resume:

        ckpt = CheckpointManager("ckpts", keep=3)
        start = ckpt.restore_latest(model)          # 0 if none
        for step in range(start, total):
            ...
            ckpt.save(step, model)                  # every save_every steps
    """

    def __init__(self, directory: str, keep: int = 3, save_every: int = 1,
                 asynchronous: bool = False):
        """asynchronous: save() copies the states to the host on the
        caller's thread, then writes the file and prunes old ones on a
        background thread; wait() (which save() and restore_latest()
        call) re-raises a failed write.  With more than one process the
        save stays synchronous: its end-of-save barrier is a collective,
        which must not interleave with a training step's."""
        self.dir = directory
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.keep = keep
        self.save_every = max(1, save_every)
        self.asynchronous = asynchronous
        self._pending = None
        self._executor = None
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:012d}.npz")

    def steps(self):
        out = []
        for f in os.listdir(self.dir):
            if f.startswith("ckpt_") and f.endswith(".npz"):
                try:
                    out.append(int(f[5:-4]))
                except ValueError:
                    pass
        return sorted(out)

    def save(self, step: int, model, aux: Optional[Dict] = None,
             force: bool = False) -> Optional[str]:
        if not force and step % self.save_every:
            return None
        self.wait()                      # one in-flight write at a time
        path = self._path(step)
        a = dict(aux or {})
        a["step"] = int(step)
        arrays, full_aux = _collect(model, a)

        def _write():
            if _process_index() == 0:
                save_arrays(arrays, path, full_aux)
                for old in self.steps()[:-self.keep]:
                    with contextlib.suppress(OSError):
                        os.unlink(self._path(old))
            _barrier()

        if self.asynchronous and _process_count() == 1:
            if self._executor is None:
                from concurrent.futures import ThreadPoolExecutor
                self._executor = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="singa-ckpt")
            self._pending = self._executor.submit(_write)
        else:
            _write()
        return path

    def wait(self) -> None:
        """Block until the in-flight asynchronous write (if any) lands;
        re-raises any exception the background write hit."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def restore_latest(self, model) -> int:
        """Load the newest intact checkpoint; returns the step after it
        (0 when starting fresh).  Only a file that cannot be read (a
        torn write) falls back to an older one: a checkpoint that reads
        but does not fit the model raises."""
        try:
            self.wait()
        except Exception as e:
            import warnings
            warnings.warn(
                f"a background checkpoint save had failed "
                f"({type(e).__name__}: {e}); restoring from the files "
                f"on disk", stacklevel=2)
        for step in reversed(self.steps()):
            try:
                arrays, aux = load_arrays(self._path(step))
            except Exception:
                continue  # torn/corrupt file: fall back to the previous
            _apply(model, arrays, aux)
            return step + 1
        return 0
