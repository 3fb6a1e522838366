"""``python -m registrar_tpu_torch`` entry point (the reference's `node main.js`).

Guarded so that importing the module (as the package's import checks
do) starts no daemon."""

from registrar_tpu_torch.main import main

if __name__ == "__main__":
    main()
