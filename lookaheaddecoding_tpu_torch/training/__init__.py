"""Single-device next-token training (the sharded step is not ported)."""
from .train_step import init_opt_state, make_train_step, next_token_loss
