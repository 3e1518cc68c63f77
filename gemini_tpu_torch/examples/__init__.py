"""The port's command-line entry points, counterparts of gemini_tpu's
examples/{snark,psnark,pc}.py (the reference's examples/*.rs):

    python -m gemini_tpu_torch.examples.snark -i 12 --time-prover
    python -m gemini_tpu_torch.examples.psnark -i 10 [--elastic | --giant]
    python -m gemini_tpu_torch.examples.pc -d 12 -p 4 -m 3

Each runs on the card, or on the CPU with `--cpu`; without a card and
without `--cpu` it raises RuntimeError.  `main(argv)` runs one in
process and returns what it built.
"""
