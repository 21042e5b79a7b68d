"""TxPool: admission (batch sig-verify on device), pool storage, sealing (the
port's copy of the JAX package's ``txpool``)."""

from .txpool import TxPool, TxSubmitResult  # noqa: F401
from .validator import TxValidator, batch_admit  # noqa: F401
