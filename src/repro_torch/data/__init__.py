"""Learner-batch producers (``pipeline``). Counterpart of
``repro/data``."""
