"""The paper's experiment script on the port: ``transf_exp_main`` (run as
``python -m transformers4rec_tpu_torch.paper_repro.transf_exp_main``) and
the four paper datasets' schemas (``datasets_configs``)."""
