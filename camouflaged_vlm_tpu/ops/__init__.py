from .norms import layer_norm
from .window import window_partition, window_unpartition
from .rel_pos import get_rel_pos_table, attention_with_decomposed_rel_pos
from .fft_prompt import fft_highpass
from .resize import resize_bilinear
from .pooling import max_pool_2d, morphological_edge
