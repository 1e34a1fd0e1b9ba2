from .kernel import (MLP, Kernel, generate_kernel, weights_to_numpy,
                     weights_to_torch)

__all__ = ["MLP", "Kernel", "generate_kernel", "weights_to_numpy",
           "weights_to_torch"]
