"""Compact ResNet (the paper's own model family, He et al. 2015): the
port's copy of ``repro/configs/resnet50_cifar.py``. The paper trains
ResNet-50 on ImageNet 1K; the default here is a narrow ResNet on synthetic
image data, and the dataclass also describes the paper-scale layout."""
from dataclasses import dataclass


@dataclass(frozen=True)
class ResNetConfig:
    name: str = "resnet-tiny"
    stage_sizes: tuple = (1, 1, 1)
    width: int = 16
    num_classes: int = 10
    image_size: int = 16
    citation: str = "arXiv:1512.03385 (paper trains ResNet-50)"


CONFIG = ResNetConfig()
