"""PyTorch/CUDA port of the basis-rotation asynchronous-pipeline system.

Each module mirrors the JAX reference module of the same path under
``repro/`` and is held to it by the ``tests/test_torch_*.py`` tests. This
package imports neither JAX nor the reference package.
"""
