from .heat import MODELS, Heat2D, Heat3D, HeatModel, get_model  # noqa: F401
