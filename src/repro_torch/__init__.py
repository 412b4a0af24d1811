"""PyTorch/CUDA port of the Migratory-Strategy Framework (reproduction of
"Programming Strategies for Irregular Algorithms on the Emu Chick").

The package mirrors the JAX package ``repro`` module for module and imports
nothing of it: ``core`` (strategies and the three algorithms), ``sparse``
(containers and input generators), ``kernels`` (the hand-written CUDA
kernels and their plain PyTorch versions), ``engine``
(``run(Request(op, inputs, strategy, substrate))`` on the ``local`` and
``cuda`` substrates) and ``convert`` (building the port's containers from
numpy arrays).
"""
