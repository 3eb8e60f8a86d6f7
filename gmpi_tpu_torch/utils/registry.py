"""Component registry: named factories for models, datasets and renderers
(port of ``gmpi_tpu/utils/registry.py``; the reference's
``gmpi/utils/registry.py``, a habitat-style singleton)."""

from __future__ import annotations

from typing import Any, Dict, Optional


class Registry:
    def __init__(self):
        self._groups: Dict[str, Dict[str, Any]] = {}

    def register(self, group: str, name: Optional[str] = None):
        """Decorator that files ``obj`` under ``group`` as ``name`` (its
        ``__name__`` when None)."""
        def deco(obj):
            key = name or getattr(obj, "__name__", str(obj))
            self._groups.setdefault(group, {})[key] = obj
            return obj

        return deco

    def get(self, group: str, name: str):
        try:
            return self._groups[group][name]
        except KeyError:
            known = sorted(self._groups.get(group, {}))
            raise KeyError(f"{group}/{name} not registered; known: {known}") from None

    def list(self, group: str):
        return sorted(self._groups.get(group, {}))


registry = Registry()

# decorators of the reference's API shape
register_model = lambda name=None: registry.register("model", name)  # noqa: E731
register_dataset = lambda name=None: registry.register("dataset", name)  # noqa: E731
register_renderer = lambda name=None: registry.register("renderer", name)  # noqa: E731
