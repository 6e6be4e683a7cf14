from repro_torch.data.pipeline import (metric_learning_pairs,
                                       nonsmooth_quadratic_problem,
                                       synthetic_mnist_like)
