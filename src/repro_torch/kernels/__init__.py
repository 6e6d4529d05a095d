"""The CUDA kernels' wrappers, their plain twins, dense oracles and the build.

Nothing here compiles at import: ``build`` runs at the first kernel launch.
"""
