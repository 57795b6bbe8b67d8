"""CapsuleNet on SVHN: a mixed plain + residual capsule stack.

Counterpart of ``repro/configs/capsnet_svhn.py``.  Street-view digits at
CIFAR geometry (32x32x3): PrimaryCaps emits 2048 capsules of 8D, a plain
bottleneck layer routes them to 64 capsules x 8D, two reversible
``ResCapsBlock``s follow, then ClassCaps (10 x 16D).  Selectable as
``--arch capsnet-svhn``.
"""

from repro_torch.core.capsnet import CapsLayerSpec, CapsNetConfig, ResCapsBlock


def config() -> CapsNetConfig:
    return CapsNetConfig(
        image_hw=32,
        in_channels=3,
        conv1_channels=256,
        conv1_kernel=9,
        pc_kernel=9,
        pc_stride=2,
        num_primary_groups=32,
        primary_dim=8,
        num_classes=10,
        class_dim=16,
        decoder_hidden=(512, 1024),
        caps_layers=(CapsLayerSpec(num_caps=64, caps_dim=8),
                     ResCapsBlock(), ResCapsBlock()),
    )


def smoke_config() -> CapsNetConfig:
    """Same topology (plain bottleneck + 2 blocks), toy widths."""
    return CapsNetConfig(
        image_hw=16,
        in_channels=3,
        conv1_channels=32,
        conv1_kernel=5,
        pc_kernel=3,
        pc_stride=2,
        num_primary_groups=4,
        primary_dim=4,
        class_dim=8,
        decoder_hidden=(32, 64),
        caps_layers=(CapsLayerSpec(num_caps=16, caps_dim=4),
                     ResCapsBlock(), ResCapsBlock()),
    )
