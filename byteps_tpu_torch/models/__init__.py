"""Model families of the port: the GPT family and its generation."""

from byteps_tpu_torch.models.convert import params_from_numpy  # noqa: F401
from byteps_tpu_torch.models.generate import make_generate_fn  # noqa: F401
from byteps_tpu_torch.models.gpt import (  # noqa: F401
    GPT,
    GPTConfig,
    gpt_forward,
    gpt_init,
)
