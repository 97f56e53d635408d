from repro_torch.data.synthetic import make_glm_data  # noqa: F401
