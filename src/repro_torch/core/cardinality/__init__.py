from .features import build_training_set, featurize, multi_eps_counts  # noqa: F401
from .rmi import RMI, MLP, RMIConfig, rmi_from_jax, rmi_predict, rmi_predict_counts, rmi_route  # noqa: F401
from .training import TrainedEstimator, train_mlp, train_rmi  # noqa: F401
