"""The data layer: DOTA parsing and samples (``dota.py``), augmentations
(``augment.py``), batching (``loader.py``), the pre-augmented shard cache
(``shards.py``), sampling weights (``tools.py``) and the bundled
hyperparameter set (``configs/``)."""
