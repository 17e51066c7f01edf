"""Models of the port: the paper's CNN and MLP on tensors, and the LM
zoo's dense attention and RWKV-6 stacks (``Transformer``)."""
from repro_torch.models.cnn import CNN
from repro_torch.models.mlp import MLP
from repro_torch.models.params import (ParamDef, add_leading_axis,
                                       flatten_defs, init_params,
                                       param_count, params_from_numpy,
                                       params_to_numpy)
from repro_torch.models.transformer import Transformer

__all__ = ["CNN", "MLP", "ParamDef", "Transformer", "add_leading_axis",
           "flatten_defs", "init_params", "param_count",
           "params_from_numpy", "params_to_numpy"]
