"""Runnable walkthroughs of the port, the counterparts of the JAX package's
``examples/`` scripts, each run as ``python -m
transformers4rec_tpu_torch.examples.<name>`` (on the card; ``--cpu`` asks
for the CPU) and callable as ``main(argv)``:

- ``getting_started``: synthetic sessions, a schema-driven next-item model,
  train, evaluate and predict the top 10;
- ``end_to_end``: raw events, the session ETL with Categorify, training
  over daily windows, the export and the HTTP server on raw item ids;
- ``serving_export``: train briefly, export, serve batches from the
  artifact alone;
- ``large_vocab_stress``: an item table row-sharded over a model axis of
  ranks, trained by sampled softmax (or the vocab-parallel full softmax).
"""
