"""The plain reference that decides `correct`: plain PyTorch and NumPy, no
kernel, no graph, no tree, no wavefront sort. It imports nothing of JAX, of
the JAX package or of the port (`portbench.guard.reference_imports` checks
its sources), and takes nothing the port made: it reads the cell's
`SceneSpec` and works out its own geometry from it."""
