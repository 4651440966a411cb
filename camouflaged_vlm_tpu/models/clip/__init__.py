from .tokenizer import ClipTokenizer, tokenize
from .model import AlphaClipConfig, build_causal_mask
from .prompt_learner import (
    PromptLearnerConfig,
    ClassPromptBank,
    build_class_prompt_bank,
    ctx_init_embedding,
)
