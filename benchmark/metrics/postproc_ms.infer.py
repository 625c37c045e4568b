"""Mean host ms of the port's post-processing
(``non_max_suppression_from_maps`` at the cell's settings, ended by a
synchronize) on the forward's maps, over every pool batch of a predict
cell."""


def read(obs):
    return obs.get("postproc_ms") if obs["kind"] == "predict" else None
