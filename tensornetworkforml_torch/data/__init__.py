from tensornetworkforml_torch.data.diagonals import create_dataset
from tensornetworkforml_torch.data.loader import ArrayLoader, NumpyDataset, prepare_dataset
from tensornetworkforml_torch.data.mnist import (
    get_MNIST_dataset,
    max_pool_2x2,
    synthetic_mnist,
)

__all__ = [
    "create_dataset",
    "ArrayLoader",
    "NumpyDataset",
    "prepare_dataset",
    "get_MNIST_dataset",
    "max_pool_2x2",
    "synthetic_mnist",
]
