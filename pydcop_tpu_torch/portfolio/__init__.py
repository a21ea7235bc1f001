"""The learned portfolio's host parts: so far the structural featurizer
(:mod:`pydcop_tpu_torch.portfolio.features`); the dataset, the model and
the selection policy wait for ROADMAP A9."""
