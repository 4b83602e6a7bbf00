"""repro_torch — FedGAT federated training and serving in PyTorch, with
hand-written CUDA kernels for the fused polynomial-attention aggregation
and its backward (and the sequence kernels), and the language-model zoo
(``repro_torch.models``) with its train and serve CLIs.

The package mirrors ``repro``'s layout (``repro_torch/core/gat.py`` is the
counterpart of ``repro/core/gat.py``, and so on) and is held against it by
the ``tests/test_torch_*.py`` tests. It imports ``torch`` and numpy and
nothing of ``repro`` or ``jax``.

Entry points (:func:`~repro_torch.federated.trainer.run_federated`,
:class:`~repro_torch.serving.server.GraphInferenceServer`,
:class:`~repro_torch.core.fedgat_model.FedGAT`, ``Model.init``, the train
and serve CLIs) run on the
CUDA device unless the caller passes ``device="cpu"``; with no card they
raise rather than drop to the CPU (see :mod:`repro_torch._device`).
"""
