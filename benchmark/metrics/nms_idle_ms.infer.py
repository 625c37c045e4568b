"""Device-idle ms a predict call whose gap lies (by its middle) inside the
port's ``postproc.nms`` span: the tier's read, the greedy sweeps' reads
and the launches between them, traced over two calls."""

from benchmark.port_spans import idle_ms


def read(obs):
    return idle_ms(obs, "predict", ("postproc.nms",))
