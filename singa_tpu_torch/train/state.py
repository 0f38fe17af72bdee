"""RunState — the schema-versioned resume bundle of a training run,
ported from ``singa_tpu/train/state.py``.

A checkpoint that holds only params+moments can restore the *model*,
but not the *run*: the data-iterator position, the RNG trajectory, and
the step/epoch counters are what make a resumed run reproduce the
uninterrupted one bit-for-bit.  RunState packages exactly that state as a
plain JSON-able dict carried in the checkpoint aux (under
:data:`AUX_RUN_STATE`), versioned so a future layout change fails
loudly instead of resuming from a misread bundle.

Conventions:

* ``step`` counts **completed** steps — a RunState with ``step=k``
  resumes execution at step index ``k`` (0-based).
* ``rng_states`` holds the ``get_state()`` bytes, as lists of ints, of
  every ``torch.Generator`` a step draws from: the model device's
  generator first, then each other generator of a ``Dropout`` layer in
  module order.  Restoring them makes the dropout masks (eager or
  drawn by a captured step's replays, which advance a registered
  generator as eager calls do) replay the uninterrupted sequence.
  Where the reference stores a JAX PRNG key (``rng_key``), the port
  stores these states, so the two packages' bundles carry different
  versions and neither resumes the other's RNG.
* ``data_state`` is whatever the loader's ``state_dict()`` returned
  (see :meth:`singa_tpu_torch.utils.data.DataLoader.state_dict`); it is
  applied back verbatim via ``load_state_dict``.
* ``model_step_count`` restores ``Model._step_count``; the optimizer's
  counter comes back through the checkpoint's ``aux["optimizer"]``
  (``Optimizer.set_states`` fills its device counter in place, so a
  captured step that reads it by address sees the restored value).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from ..obs import schema

__all__ = ["RunState", "AUX_RUN_STATE", "RUN_STATE_VERSION",
           "step_generators"]

#: aux key the orchestrator stores the bundle under
AUX_RUN_STATE = "run_state"

#: bump when the bundle layout changes incompatibly.  1 is the JAX
#: package's layout (a PRNG key); 2 is this one (generator states)
RUN_STATE_VERSION = 2


def step_generators(model) -> List[torch.Generator]:
    """The generators a training step of `model` may draw from, in a
    fixed order: the device's, then each other generator a captured step
    registers (the distinct ones of ``Dropout`` layers with p > 0, in
    module order).  Empty for a model with neither."""
    from ..model import _dropout_generators
    gens: List[torch.Generator] = []
    dev_gen = getattr(getattr(model, "device", None), "generator", None)
    if isinstance(dev_gen, torch.Generator):
        gens.append(dev_gen)
    if hasattr(model, "modules"):
        gens += [g for g in _dropout_generators(model) if g is not dev_gen]
    return gens


@dataclasses.dataclass
class RunState:
    step: int                               # steps completed so far
    epoch: int                              # data epochs completed
    data_state: Optional[Dict[str, Any]]    # DataLoader.state_dict()
    rng_states: Optional[List[List[int]]]   # step_generators' states
    model_step_count: int                   # Model._step_count
    run_id: str
    version: int = RUN_STATE_VERSION

    # -- capture / restore -------------------------------------------------
    @classmethod
    def capture(cls, model, loader, step: int, run_id: str,
                data_state: Optional[Dict[str, Any]] = None) -> "RunState":
        """Snapshot the run-level state after ``step`` completed steps.

        ``data_state`` overrides the loader's live cursor (the
        emergency-checkpoint path passes the pre-draw cursor of a step
        that never completed)."""
        if data_state is None and loader is not None \
                and hasattr(loader, "state_dict"):
            data_state = dict(loader.state_dict())
        gens = step_generators(model)
        # get_state() of a CUDA generator reads its host-side seed and
        # offset (a captured step's replays advance the offset on the
        # host), so this needs no device sync
        rng = [g.get_state().tolist() for g in gens] if gens else None
        # .get: the loader contract is duck-typed (any state_dict()
        # counts), and capture runs inside the emergency-checkpoint
        # path where a KeyError would lose the save
        epoch = int(data_state.get("epoch", 0)) if data_state else 0
        return cls(step=int(step), epoch=epoch, data_state=data_state,
                   rng_states=rng,
                   model_step_count=int(getattr(model, "_step_count", 0)),
                   run_id=str(run_id))

    def apply(self, model, loader=None) -> None:
        """Restore the captured trajectory onto a fresh model/loader
        (params and optimizer moments are the checkpoint file's job —
        this handles everything around them)."""
        if self.rng_states is not None:
            gens = step_generators(model)
            if len(gens) != len(self.rng_states):
                raise ValueError(
                    f"run_state holds {len(self.rng_states)} generator "
                    f"states but the model's step draws from {len(gens)} "
                    f"generators — refusing to resume another RNG "
                    f"trajectory")
            for g, st in zip(gens, self.rng_states):
                g.set_state(torch.tensor(st, dtype=torch.uint8))
        if hasattr(model, "_step_count"):
            model._step_count = int(self.model_step_count)
        if (loader is not None and self.data_state is not None
                and hasattr(loader, "load_state_dict")):
            loader.load_state_dict(self.data_state)

    # -- (de)serialization -------------------------------------------------
    def to_aux(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_aux(cls, aux: Any, ctx: str = "run_state") -> "RunState":
        ver = schema.require(aux, "version", ctx)
        if ver != RUN_STATE_VERSION:
            raise schema.SchemaError(
                f"{ctx}: version {ver!r} is not the supported "
                f"{RUN_STATE_VERSION} — refusing to resume from a bundle "
                f"this code cannot interpret", field="version")
        return cls(step=int(schema.require(aux, "step", ctx)),
                   epoch=int(schema.require(aux, "epoch", ctx)),
                   data_state=aux.get("data_state"),
                   rng_states=aux.get("rng_states"),
                   model_step_count=int(
                       schema.require(aux, "model_step_count", ctx)),
                   run_id=str(schema.require(aux, "run_id", ctx)),
                   version=int(ver))
