# The JAX package's version: config.keyspace() derives the store's table
# namespace from it, so both packages name the same tables.
__version__ = "0.2.0"
