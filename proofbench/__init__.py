"""proofbench: the benchmark of the PyTorch and CUDA port
(`gemini_tpu_torch`).  One command runs one cell once:

    python3 proofbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""
