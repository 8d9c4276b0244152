"""DARTH on PyTorch and CUDA (NVIDIA Hopper): a port of the ``repro`` JAX
package's declarative-recall search over IVF and HNSW. It imports neither
JAX nor ``repro``; entry points that create tensors default to
``device="cuda"``.
"""
