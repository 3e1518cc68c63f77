from .commit import CommitterKey, VerifierKey, KZGVerificationError
