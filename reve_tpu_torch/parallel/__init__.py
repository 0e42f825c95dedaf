"""Several CUDA devices: the engine's data-parallel mesh (`mesh.py`) and a
process's worker identity for the segment lease queue
(`distributed.py`)."""
