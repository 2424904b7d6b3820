# Entry points of the port: serve.py (prefill + decode), train.py (the
# trainer), api.py (steps and the cells' specs), mesh.py (device meshes).
