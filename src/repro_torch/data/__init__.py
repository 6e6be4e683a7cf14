from repro_torch.data.pipeline import (TokenStream, metric_learning_pairs,
                                       nonsmooth_quadratic_problem,
                                       partition_rows,
                                       synthetic_mnist_like)
