from .host import HostVector, VirtualHostVector
from .sumcheck import SpaceProver, ElasticProver
from .kzg import (
    CommitterKeyStream, FakeCommitterKeyStream, divide_linear_stream,
)
from .ops import (
    hv_accumulated_product, hv_hadamard, hv_lincomb, hv_prod,
)
from . import tensorcheck
