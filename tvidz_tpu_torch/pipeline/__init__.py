"""The port's streaming analyzer and checkpoints; the progress registry and
the decode prefetcher are the reference's, through ``_reference``."""
