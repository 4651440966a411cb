from .sam_encoder import SamEncoderConfig
from .two_way_transformer import TwoWayTransformerConfig
from .mask_decoder import MaskDecoderConfig
from .position_embedding import random_position_embedding
from .cascade import CascadeConfig, OVCOSCascade
