from .dtypes import torch_dtype  # noqa: F401
