"""singa_tpu_torch.models — the model families ported so far: the
Llama family with the causal-LM losses, GPT-2 and BERT, and the vision
zoo (MLP, CNN, LeNet-5, AlexNet, ResNet-18/34/50/101/152,
VGG-11/13/16/19)."""

from . import cnn, convert, llama, mlp, resnet, transformer, vgg
from .cnn import CNN, AlexNet, LeNet5
from .convert import (HFLayout, from_hf, from_hf_bert, from_hf_gpt2,
                      from_hf_llama, from_hf_mistral, from_hf_mixtral,
                      hf_layout, load_reference_params,
                      load_reference_states, to_hf)
from .llama import Llama, LlamaConfig
from .mlp import MLP
from .transformer import BERT, GPT2, BERTConfig, GPT2Config
from .resnet import (ResNet, resnet18, resnet34, resnet50, resnet101,
                     resnet152)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19

__all__ = ["cnn", "convert", "llama", "mlp", "resnet", "transformer", "vgg",
           "MLP", "CNN", "LeNet5", "AlexNet", "ResNet", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152", "VGG", "vgg11",
           "vgg13", "vgg16", "vgg19", "Llama", "LlamaConfig", "GPT2",
           "GPT2Config", "BERT", "BERTConfig", "from_hf", "from_hf_gpt2",
           "from_hf_llama", "from_hf_mistral", "from_hf_mixtral",
           "from_hf_bert", "HFLayout", "hf_layout", "to_hf",
           "load_reference_params", "load_reference_states"]
