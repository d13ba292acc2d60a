"""The configuration schema, shared with the JAX package (it imports no JAX).

Re-exported so that callers of the port name one package only."""

from tubelet_transformer_tpu.config import Config, load_config  # noqa: F401
