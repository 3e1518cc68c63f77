from .r1cs import R1cs, SparseMatrix, dummy_r1cs, random_r1cs
