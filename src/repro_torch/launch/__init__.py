# Entry points of the port: serve.py (prefill + decode on one device).
