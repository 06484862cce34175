"""Component registry (``common/baseline_registry.py``): trainer name ->
class, so configs select the trainer by TRAINER_NAME."""

from typing import Any, Dict, Optional


class Registry:
    def __init__(self):
        self._trainers: Dict[str, Any] = {}

    def register_trainer(self, obj=None, *, name: Optional[str] = None):
        def wrap(cls):
            self._trainers[name or cls.__name__] = cls
            return cls

        return wrap(obj) if obj is not None else wrap

    def get_trainer(self, name: str):
        return self._trainers.get(name)


registry = Registry()
