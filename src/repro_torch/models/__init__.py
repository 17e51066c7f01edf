"""Models of the ported slice: the paper's CNN and MLP on tensors."""
from repro_torch.models.cnn import CNN
from repro_torch.models.mlp import MLP
from repro_torch.models.params import (ParamDef, init_params, param_count,
                                       params_from_numpy, params_to_numpy)

__all__ = ["CNN", "MLP", "ParamDef", "init_params", "param_count",
           "params_from_numpy", "params_to_numpy"]
