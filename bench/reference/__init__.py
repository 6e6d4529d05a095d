"""The plain reference of the benchmark: the data generator and FALKON
(paper Alg. 1) in plain PyTorch, computed in blocks of rows so that it
fits beside nothing else on the card. It imports nothing of the program
(``repro_torch``), of the JAX package or of ``jax``."""
