"""Device selection and the JAX -> torch weight bridge of the port."""
