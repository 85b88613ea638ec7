"""``python -m spacetpu_torch``: the app (see `spacetpu_torch.main`)."""

from spacetpu_torch.main import main

if __name__ == "__main__":
    main()
