from . import sumcheck
