"""Hook base (counterpart of `pointcept_tpu/engines/hooks/default.py`;
parity target: reference `pointcept/engines/hooks/default.py:13`)."""

from __future__ import annotations


class HookBase:
    """Base hook with before/after train/epoch/step events; `self.trainer` is
    set by `TrainerBase.register_hooks`."""

    trainer = None

    def before_train(self):
        pass

    def before_epoch(self):
        pass

    def before_step(self):
        pass

    def after_step(self):
        pass

    def after_epoch(self):
        pass

    def after_train(self):
        pass
