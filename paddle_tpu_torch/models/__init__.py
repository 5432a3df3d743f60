"""Models of the port (counterpart of paddle_tpu/models/): GPT, ERNIE / BERT and
the CTR models Wide&Deep and DeepFM (the vision models are in vision/models/)."""
from .convert import (gather_to_jax, gpt_state_from_pipe, layer_state_from_jax,
                      load_jax_state, pipe_state_from_gpt, state_from_jax)
from .ernie import (BertConfig, BertForPretraining, BertModel, ErnieBlock, ErnieConfig,
                    ErnieForPretraining, ErnieModel, ErnieSelfAttention, bert_base, bert_large,
                    ernie_base, ernie_large, ernie_tiny)
from .gpt import (GPTAttention, GPTBlock, GPTConfig, GPTForPretraining,
                  GPTForPretrainingPipe, GPTMLP, GPTModel, gpt_1p3b, gpt_345m, gpt_tiny)
from .rec import DeepFM, WideDeep, ctr_loss

__all__ = ["BertConfig", "BertForPretraining", "BertModel", "ErnieBlock", "ErnieConfig",
           "ErnieForPretraining", "ErnieModel", "ErnieSelfAttention", "bert_base",
           "bert_large", "ernie_base", "ernie_large", "ernie_tiny", "GPTAttention", "GPTBlock", "GPTConfig", "GPTForPretraining",
           "GPTForPretrainingPipe", "pipe_state_from_gpt", "gpt_state_from_pipe",
           "GPTMLP", "GPTModel", "gpt_1p3b", "gpt_345m", "gpt_tiny", "load_jax_state",
           "layer_state_from_jax", "state_from_jax", "gather_to_jax", "WideDeep", "DeepFM", "ctr_loss"]
