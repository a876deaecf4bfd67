"""Process groups, explicit collectives and parameter sharding for runs on
several ranks (counterpart of makani_tpu/parallel/)."""
