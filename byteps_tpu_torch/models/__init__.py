"""Model families of the port: the GPT family and its MoE sibling, their
generation (greedy speculative decoding included), LoRA adapters, training steps (data, tensor, sequence,
pipeline and expert parallel) and the eval step."""

from byteps_tpu_torch.models.convert import (  # noqa: F401
    adapters_from_numpy,
    adapters_to_numpy,
    flat_leaves,
    params_from_numpy,
    params_to_numpy,
)
from byteps_tpu_torch.models.generate import make_generate_fn  # noqa: F401
from byteps_tpu_torch.models.gpt import (  # noqa: F401
    GPT,
    GPTConfig,
    gpt_forward,
    gpt_init,
    gpt_loss,
    gpt_pp_loss,
)
from byteps_tpu_torch.models.moe_gpt import (  # noqa: F401
    MoEGPTConfig,
    moe_gpt_init,
    moe_gpt_loss,
    moe_gpt_pp_loss,
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
    make_gpt_train_step,
    synthetic_batch,
)
