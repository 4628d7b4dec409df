from . import nc3, spifs  # noqa: F401
