from repro_torch.data.synthetic import eval_accuracy, linear_classification_problem

__all__ = ["eval_accuracy", "linear_classification_problem"]
