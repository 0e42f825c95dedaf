"""The web service of the port: reve_tpu/service over pipeline/job.py."""
