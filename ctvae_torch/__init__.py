"""PyTorch + CUDA port of the CT-MCQ-VAE: serving, training and the
two-stage recipe.

Layout mirrors the JAX package (``ops/``, ``models/``, ``serving/``,
``training/``, ``data/``, ``utils/``; ``run.py`` is the training entry
point, ``causal_train.py`` and ``apply_action.py`` the two-stage recipe's
runner and its rollout tool, ``hyperparameter_search.py`` the search
of ``configs_hyp/``);
public functions keep its layouts (NHWC images, ``[B, S, N]``
sequences, ``adj[b, s, t]`` = edge s -> t). The hot ops run through
hand-written CUDA kernels (``csrc/``) built with ``nvcc`` at first use;
on CPU tensors each op runs its plain PyTorch version.
"""
