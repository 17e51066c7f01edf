"""The paper's CNN (§IV-A): the standard FL-MNIST CNN (McMahan et al.).

conv5x5x32 -> maxpool2 -> conv5x5x64 -> maxpool2 -> fc512 -> fc10.
~1.66M parameters; trained with mini-batch SGD, batch 32, lr 0.01.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class PaperCnnConfig:
    name: str = "paper-cnn"
    image_size: int = 28
    channels: tuple = (32, 64)
    kernel: int = 5
    hidden: int = 512
    num_classes: int = 10
    batch_size: int = 32
    learning_rate: float = 0.01


CONFIG = PaperCnnConfig()
