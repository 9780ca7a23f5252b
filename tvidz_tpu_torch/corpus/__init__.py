"""The port's on-device corpus (``device_corpus.DeviceCorpus``); the durable
store is the reference's, reached through ``tvidz_tpu_torch._reference``."""
