"""K3, the compactor fold (``ops/compactor.py``, ``csrc/compactor_fold.cu``):
named so that its time is kept apart from the torch ops'. No cell reads its
roofline yet."""

NAMES = ("compactor",)
