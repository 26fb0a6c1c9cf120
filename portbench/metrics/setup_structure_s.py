"""Host seconds of the structure and the model (``models/crossbar.py``,
``lattice.py``, ``VCMModel.__init__``), each part synchronised."""


def read(ctx):
    parts = ctx.setup.parts
    return sum(parts.get(k, 0.0) for k in ("structure_s", "lattice_s", "model_s"))
