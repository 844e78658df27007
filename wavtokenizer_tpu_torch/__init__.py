"""PyTorch/CUDA port of the WavTokenizer codec, held against the JAX package
``wavtokenizer_tpu`` (the reference).  Imports torch and numpy only."""

from .api.pretrained import Vocos, WavTokenizer, from_jax_params
from .models.init import init_vocos, init_wavtokenizer
from .models.quantize import VQConfig
from .models.seanet import SEANetConfig
from .models.vocos import ISTFTHeadConfig, VocosBackboneConfig
from .models.wavtokenizer import WavTokenizerSpec
