"""Model families of the port: the GPT family and its MoE sibling, their
generation (greedy speculative decoding included), LoRA adapters, training
steps (data, tensor, sequence, pipeline and expert parallel) and the eval
step; BERT, ViT, T5 (with cached seq2seq generation) and ResNet with
their train steps; and the HuggingFace checkpoint bridge for the GPT
family (``import_hf``)."""

from byteps_tpu_torch.models.bert import (  # noqa: F401
    BertConfig,
    bert_forward,
    bert_init,
    bert_mlm_loss,
)
from byteps_tpu_torch.models.convert import (  # noqa: F401
    adapters_from_numpy,
    adapters_to_numpy,
    flat_leaves,
    params_from_numpy,
    params_to_numpy,
    resnet_state_from_numpy,
    shard_tree,
    tree_from_numpy,
    tree_to_numpy,
)
from byteps_tpu_torch.models.generate import make_generate_fn  # noqa: F401
from byteps_tpu_torch.models.gpt import (  # noqa: F401
    GPT,
    GPTConfig,
    ParamTree,
    gpt_forward,
    gpt_init,
    gpt_loss,
    gpt_pp_loss,
)
from byteps_tpu_torch.models.import_hf import (  # noqa: F401
    from_hf_gpt2,
    from_hf_llama,
    to_hf_gpt2,
    to_hf_llama,
)
from byteps_tpu_torch.models.moe_gpt import (  # noqa: F401
    MoEGPTConfig,
    moe_gpt_init,
    moe_gpt_loss,
    moe_gpt_pp_loss,
)
from byteps_tpu_torch.models.resnet import (  # noqa: F401
    ResNetConfig,
    resnet_forward,
    resnet_init,
    resnet_loss,
)
from byteps_tpu_torch.models.speculative import (  # noqa: F401
    make_lookup_generate_fn,
    make_speculative_generate_fn,
)
from byteps_tpu_torch.models.train import (  # noqa: F401
    evaluate_perplexity,
    make_eval_step,
    make_gpt_moe_pp_train_step,
    make_gpt_moe_train_step,
    make_gpt_pp_train_step,
    make_bert_train_step,
    make_gpt_train_step,
    make_resnet_train_step,
    make_t5_train_step,
    make_vit_train_step,
    synthetic_batch,
    synthetic_mlm_batch,
)
from byteps_tpu_torch.models.t5 import (  # noqa: F401
    T5Config,
    make_t5_generate_fn,
    synthetic_seq2seq_batch,
    t5_decode,
    t5_decode_cached,
    t5_encode,
    t5_forward,
    t5_init,
    t5_loss,
)
from byteps_tpu_torch.models.vit import (  # noqa: F401
    ViTConfig,
    synthetic_vit_batch,
    vit_forward,
    vit_init,
    vit_loss,
)
