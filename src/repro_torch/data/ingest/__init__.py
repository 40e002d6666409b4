"""Dataset ingestion: the libsvm/svmlight parser
(:mod:`repro_torch.data.ingest.libsvm`).  The reference's registry, cache
and fixture modules are not ported yet."""
