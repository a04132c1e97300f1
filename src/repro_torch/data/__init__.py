from repro_torch.data.movielens import MovieLensTwin, movielens_twin, rmse
from repro_torch.data.synthetic import (eval_accuracy, linear_classification_problem,
                                        token_stream)

__all__ = ["MovieLensTwin", "eval_accuracy", "linear_classification_problem", "movielens_twin",
           "rmse", "token_stream"]
