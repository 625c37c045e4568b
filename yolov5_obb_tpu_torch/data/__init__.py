"""The eval half of the DOTA data layer (``dota.py``, ``augment.py``) and
the bundled hyperparameter set (``configs/``)."""
