"""Analysis tools of the port (counterpart of ``metrics_tpu/analysis/__init__.py``).

Only the runtime lock witness is ported (:mod:`.lockwitness`); the lint
pass, its baseline and rules and the compiled-graph audit are ROADMAP
Queue 1, item 18, so this package exports none of their names yet.
"""
__all__: list = []
