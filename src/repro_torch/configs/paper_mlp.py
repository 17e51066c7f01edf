"""The paper's MLP (§IV-A): 2-hidden-layer perceptron (McMahan's 2NN).

784 -> 200 -> 200 -> 10, ~200k parameters; SGD batch 32, lr 0.01.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class PaperMlpConfig:
    name: str = "paper-mlp"
    input_dim: int = 784
    hidden: tuple = (200, 200)
    num_classes: int = 10
    batch_size: int = 32
    learning_rate: float = 0.01


CONFIG = PaperMlpConfig()
