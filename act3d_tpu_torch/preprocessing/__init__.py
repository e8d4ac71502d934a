"""Offline data-generation and preprocessing tools (host side).

Counterparts of ``act3d_tpu/preprocessing/`` (the reference's
``data_preprocessing/`` scripts):
  * compute_workspace_bounds: per-task gripper workspace JSON
  * validate: count and schema-check packaged episodes
  * preprocess_instructions: CLIP / BERT text features -> instructions.pkl
    (the encoder runs on the card unless ``--device cpu``)
  * data_gen: replay stored demos -> packaged blosc .dat episodes
  * dataset_generator: collect raw demos in the simulator

Every module imports without ``transformers``, ``PIL``, RLBench and PyRep;
those are imported inside the functions that need them.
"""
