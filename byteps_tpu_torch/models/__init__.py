"""Model families of the port: the GPT family, its generation, its LoRA
adapters, its data-parallel training step and its eval step."""

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
)
from byteps_tpu_torch.models.train import (  # noqa: F401
    evaluate_perplexity,
    make_eval_step,
    make_gpt_train_step,
    synthetic_batch,
)
