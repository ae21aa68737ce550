"""Model zoo: the TransformerLM (``models/transformer.py``) and the
classifiers registered by name for the JAXJob runner and the classifier
server (mlp, cnn, resnet18, resnet50, vit, vit-s)."""

from .cnn import CNN  # noqa: F401
from .mlp import MLP  # noqa: F401
from .registry import get_model, model_names, register_model  # noqa: F401
from .resnet import ResNet, ResNet18, ResNet50  # noqa: F401
from .vit import ViT  # noqa: F401
