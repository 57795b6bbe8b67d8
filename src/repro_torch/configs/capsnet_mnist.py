"""The paper's own workload: CapsuleNet on MNIST (Sabour et al. 2017),
profiled by CapStore.  Counterpart of ``repro/configs/capsnet_mnist.py``."""

from repro_torch.core.capsnet import CapsNetConfig


def config() -> CapsNetConfig:
    return CapsNetConfig()


def smoke_config() -> CapsNetConfig:
    return CapsNetConfig(image_hw=14, conv1_channels=32,
                         conv1_kernel=5, pc_kernel=3,
                         num_primary_groups=4, primary_dim=4,
                         class_dim=8, decoder_hidden=(32, 64))
