"""Step-keyed training curriculum (port of ``gmpi_tpu/curriculum.py``).

The reference's curriculum machinery (``gmpi/curriculums.py:50-85``): a
schedule maps step thresholds to hyperparameter updates; ``at_step`` merges
the active step entry with the global entries, ``next_upsample_step`` /
``last_upsample_step`` bracket the current stage.  GMPI itself trains
single-stage (one resolution entry).  ``stage_boundaries`` tells the training
loop where to rebuild its step, set the optimizers' learning rates and,
optionally, rebuild its data iterator.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List


@dataclasses.dataclass(frozen=True)
class Curriculum:
    """``schedule``: step-keyed dicts; ``constants``: step-independent
    entries (the reference mixes both in one dict keyed by int vs str)."""

    schedule: Dict[int, Dict[str, Any]]
    constants: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def at_step(self, step: int) -> Dict[str, Any]:
        """Active hyperparameters at ``step``
        (``curriculums.extract_metadata``, ``curriculums.py:76-85``)."""
        out = dict(self.constants)
        for threshold in sorted(self.schedule, reverse=True):
            if threshold <= step:
                out.update(self.schedule[threshold])
                break
        return out

    def next_upsample_step(self, step: int) -> int:
        """First schedule boundary after ``step`` (``curriculums.py:50-58``)."""
        later = [s for s in self.schedule if s > step]
        return min(later) if later else float("inf")

    def last_upsample_step(self, step: int) -> int:
        """Latest boundary at or before ``step`` (``curriculums.py:61-67``)."""
        earlier = [s for s in self.schedule if s <= step]
        return max(earlier) if earlier else 0

    def stage_boundaries(self) -> List[int]:
        return sorted(self.schedule)


def apply_to_config(cfg, entry: Dict[str, Any]):
    """Apply a curriculum entry's hyperparameters onto an ``ExperimentConfig``
    (``train_helpers.modify_curriculums``'s role, ``train_helpers.py:33-108``).

    Recognized keys: ``batch_size``, ``batch_split``, ``gen_lr``,
    ``disc_lr`` — hyperparameters that change the step but not the networks'
    parameters.  ``img_size``/``tex_size`` entries raise: a resolution change
    alters the generator's and discriminator's parameter shapes, which needs
    a model and optimizer state migration the loop does not implement (GMPI
    itself trains single-stage, ``curriculums.py:88-208``).  The training
    loop rebuilds its step at each ``stage_boundaries()`` crossing and sets
    the Adam groups' ``lr`` from the stage's ``gen_lr``/``disc_lr``.
    """
    if any(k in entry for k in ("img_size", "tex_size")):
        raise NotImplementedError(
            "curriculum resolution changes require a parameter-tree "
            "migration (new synthesis blocks / D layers); only "
            "batch_size/batch_split/gen_lr/disc_lr stages are supported")
    hp_keys = {"batch_size", "batch_split", "gen_lr", "disc_lr"}
    updates = {k: v for k, v in entry.items() if k in hp_keys}
    if not updates:
        return cfg
    return dataclasses.replace(
        cfg, hparams=dataclasses.replace(cfg.hparams, **updates))


def from_reference_style(d: Dict) -> Curriculum:
    """Build from a reference-style dict (int keys = schedule, str keys =
    constants)."""
    schedule = {k: dict(v) for k, v in d.items() if isinstance(k, int)}
    constants = {k: v for k, v in d.items() if not isinstance(k, int)}
    return Curriculum(schedule=schedule, constants=constants)
