from .builder import ConstraintBuilder, LinComb, Var
from .r1cs import R1cs, SparseMatrix, dummy_r1cs, random_r1cs
from .stream import (
    DenseR1csStream, DummyR1csStream, HostR1csStream, as_stream,
)
