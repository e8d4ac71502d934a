"""The port's host data path: packaged episodes (the native blosc codec,
``episode``), host augmentations, ``RLBenchDataset``, synthetic fixtures
and the pinned-memory ``DeviceFeeder`` that moves batches to the card."""
