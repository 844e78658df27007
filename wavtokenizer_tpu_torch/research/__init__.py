"""The fork's research layer: the feature-enhancement adapter and its
trainers, BYOL speaker pretraining, and the analysis helpers.  Port of
``wavtokenizer_tpu/research/``."""

from .adapter import (AdapterConfig, InPathTransformerConfig, apply_adapter,
                      enhanced_forward, init_adapter, init_inpath_transformer,
                      inpath_transformer, inpath_transformer_from_torch,
                      load_byol_transformer, try_enhancement_stack)
from .byol import BYOLConfig, byol_loss, init_byol, simple_transformer, target_update
from .enhance import EnhanceConfig, PairedAudioDataset, enhance_step, make_enhance_optimizer
from .losses import (cosine_similarity_loss, feature_loss, hybrid_tsne_loss,
                     voice_focused_loss)
