"""CapsuleNet on CIFAR-10: a deep residual capsule stack.

Counterpart of ``repro/configs/capsnet_cifar10.py``: three reversible
``ResCapsBlock``s between PrimaryCaps (2048 capsules of 8D) and ClassCaps,
so every routing layer but the last is a coupling half.  Selectable as
``--arch capsnet-cifar10``.
"""

from repro_torch.core.capsnet import CapsNetConfig, ResCapsBlock


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
        caps_layers=(ResCapsBlock(), ResCapsBlock(), ResCapsBlock()),
    )


def smoke_config() -> CapsNetConfig:
    """Same topology (3 reversible blocks), toy widths."""
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
        caps_layers=(ResCapsBlock(), ResCapsBlock(), ResCapsBlock()),
    )
