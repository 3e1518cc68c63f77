"""The benchmark's plain reference: the Gemini SNARK proof worked out in
plain PyTorch and pure Python (`snark.py` over `fr.py` and `g1.py`),
with a frozen copy of the Merlin transcript (`transcript.py`, see its
note).  It imports nothing of the program under test and takes nothing
the program made: the harness hands it the statement and the key's
trapdoor that it made itself."""
