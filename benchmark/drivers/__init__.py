"""One module a kind of timed loop: ``setup``, ``window``, ``observe``,
``release`` and ``check`` (see ``benchmark/run.py``)."""
