"""LeNet-5 configuration space, the paper's own experimental subject
(``repro.configs.lenet5``, copied value for value).

The paper (Kavarakuntla et al. 2023) measures per-iteration training time
of LeNet-5 over a sampled hyperparameter space (Table 1) and fits the
generic performance model to it; ``repro_torch.perf.sweep`` samples from
this space. ``wire_bits`` reads the port's own ``WIRE_BITS``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

# Paper Table 1: intrinsic parameters and their value sets.
KERNEL_SIZES = (2, 3, 4, 5)
POOL_SIZES = (2, 3, 4, 5)
ACTIVATIONS = ("relu", "tanh", "sigmoid")
OPTIMIZERS = ("adam", "sgd")
DATASETS = ("mnist", "fashion_mnist", "cifar10")
N_FILTERS = (4, 8, 16, 32, 64)
LEARNING_RATES = (0.1, 0.01, 0.001, 1e-4, 1e-5, 1e-6)
PADDING_MODES = ("valid", "same")
STRIDES = (1, 2, 3)
DROPOUTS = (0.2, 0.5, 0.8)
# Paper Table 1: extrinsic parameters (device counts are powers of two up
# to the reference's 8-device host pool, the axis its planner plans over).
N_DEVICES = (1, 2, 4, 8)
BATCH_SIZES = (8, 16, 32, 64, 128)
# Distribution extrinsics beyond the paper's table: the sharding strategy
# and the gradient wire format, which reshape the communication term.
DIST_STRATEGIES = ("dp", "fsdp", "tp", "fsdp_tp")
GRAD_COMPRESSIONS = ("none", "bf16", "int8")   # wire bits 32 / 16 / 8

DATASET_SHAPES = {
    "mnist": (28, 28, 1),
    "fashion_mnist": (28, 28, 1),
    "cifar10": (32, 32, 3),
}
N_CLASSES = 10


@dataclass(frozen=True)
class LeNet5Config:
    """One sampled point of the paper's hyperparameter space."""
    kernel_size: int = 5
    pool_size: int = 2
    activation: str = "relu"
    optimizer: str = "sgd"
    dataset: str = "mnist"
    n_filters: int = 16
    learning_rate: float = 0.01
    padding: str = "valid"
    stride: int = 1
    dropout: float = 0.2
    # extrinsic
    n_devices: int = 1
    batch_size: int = 32
    strategy: str = "dp"
    compression: str = "none"

    @property
    def image_shape(self) -> Tuple[int, int, int]:
        """(H, W, C), the reference's NHWC order."""
        return DATASET_SHAPES[self.dataset]

    @property
    def wire_bits(self) -> int:
        from repro_torch.dist.compression import WIRE_BITS
        return WIRE_BITS[self.compression]

    def intrinsic_dict(self) -> dict:
        return dict(kernel_size=self.kernel_size, pool_size=self.pool_size,
                    activation=self.activation, optimizer=self.optimizer,
                    dataset=self.dataset, n_filters=self.n_filters,
                    learning_rate=self.learning_rate, padding=self.padding,
                    stride=self.stride, dropout=self.dropout)

    def extrinsic_dict(self) -> dict:
        # wire_bits, the numeric footprint of the compression choice,
        # enters the fitted model as a power term like the other extrinsics
        return dict(n_devices=self.n_devices, batch_size=self.batch_size,
                    wire_bits=self.wire_bits)

    def dist_dict(self) -> dict:
        return dict(strategy=self.strategy, compression=self.compression)
